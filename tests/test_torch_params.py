"""Port parity for the analytical parameter count
(``repro_torch.models.params.count_params_analytical`` and
``ModelConfig.param_count``): equal to the reference's for all ten
configs, at full size and reduced, with and without ``active_only``; and
within the reference's 5% of the leaves the port's ``model_init`` builds
at reduced size (the count leaves out norms and biases)."""

import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.params import count_params_analytical as jcount
from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.models import model_init
from repro_torch.models.params import count_params_analytical
from repro_torch.tree import tree_paths


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_count_matches_reference(arch, size, active_only):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if size == "reduced":
        jcfg, tcfg = jreduced(jcfg), reduced(tcfg)
    want = jcount(jcfg, active_only=active_only)
    assert count_params_analytical(tcfg, active_only=active_only) == want
    assert tcfg.param_count(active_only=active_only) == want
    assert jcfg.param_count(active_only=active_only) == want


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_count_matches_model_init(arch):
    cfg = reduced(get_config(arch))
    actual = sum(t.numel() for _, t in tree_paths(
        model_init(cfg, device="cpu")))
    assert abs(actual - cfg.param_count()) / actual < 0.05, \
        (arch, actual, cfg.param_count())


def test_moe_active_count_is_smaller():
    cfg = get_config("deepseek-v3-671b")
    assert 25e9 <= cfg.param_count(active_only=True) <= 55e9
    assert cfg.param_count() > 600e9
