"""Corpus-sharded rounds over a mesh of ranks on ``torch.distributed`` (port of
``ital_tpu.parallel``: the mesh, the ring, the per-round sharded path, the
fused sessions and cohorts, and the mesh-sharded serving session)."""

from ital_tpu_torch.parallel.launch import launch  # noqa: F401
from ital_tpu_torch.parallel.mesh import CORPUS_AXIS, Mesh, make_mesh  # noqa: F401
from ital_tpu_torch.parallel.ring import ring_reduce_over_corpus  # noqa: F401
from ital_tpu_torch.parallel.sharded import (  # noqa: F401
    load_sharded_session,
    make_masks,
    make_sharded_cohort,
    make_sharded_cohort_select,
    make_sharded_cohort_update,
    make_sharded_density,
    make_sharded_fit,
    make_sharded_round,
    make_sharded_select,
    make_sharded_session,
    make_sharded_set_query,
    make_sharded_update,
    pad_to_devices,
    relearn,
    save_sharded_session,
    shard_cohort_state,
    shard_state,
)
