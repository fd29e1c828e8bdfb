from repro_torch.train.step import (  # noqa: F401
    TrainConfig,
    make_loss_fn,
    make_train_step,
)
