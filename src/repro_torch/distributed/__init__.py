"""Distributed pieces ported so far: gradient compression, the partition
rules and model-axis shards (``sharding``) and the one-process
collectives over them (``collectives``)."""
