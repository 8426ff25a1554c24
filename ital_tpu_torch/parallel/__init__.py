"""Corpus-sharded rounds over a mesh of ranks on ``torch.distributed`` (port of
``ital_tpu.parallel``: the mesh, the ring, the per-round sharded path, the
fused sessions and cohorts, the mesh-sharded serving session, and the
large-cap path's distributed Cholesky and refit)."""

from ital_tpu_torch.parallel.bigcap import (  # noqa: F401
    make_bigcap_fit,
    make_bigcap_round,
    shard_state_bigcap,
)
from ital_tpu_torch.parallel.chol2d import (  # noqa: F401
    make_sharded_cho_solve,
    make_sharded_cholesky,
    make_sharded_whiten,
)

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
    make_sharded_relearn,
    make_sharded_round,
    make_sharded_select,
    make_sharded_session,
    make_sharded_set_query,
    make_sharded_update,
    pad_to_devices,
    save_sharded_session,
    shard_cohort_state,
    shard_state,
)
