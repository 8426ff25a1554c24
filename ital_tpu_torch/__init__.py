"""ital_tpu_torch — the PyTorch/CUDA port of ``ital_tpu`` for NVIDIA Hopper GPUs.

Interactive content-based image retrieval with information-theoretic active
learning: a Gaussian-process relevance model over a fixed image-feature
corpus, greedy mutual-information batch selection against a noisy simulated
user, incremental Cholesky updates and ranking by posterior mean, and the
experiment harness that compares it with the classical baselines.

The package keeps ``ital_tpu``'s module layout and public names, imports
``torch`` and never ``jax`` or ``ital_tpu``.  Plain tensor code is PyTorch;
the RBF kernel block is a CUDA kernel written for sm_90a
(``csrc/rbf_tile.cu``), built at first use by :mod:`ital_tpu_torch.ops._build`.

Package layout
--------------
``ops``       RBF kernel (plain version + CUDA wrapper), padded Cholesky with
              the block append, Genz QMC orthant probabilities, blocking.
``models``    The GP relevance model (``GPState``) and the session API.
``select``    The strategy registry: ITAL mutual-information batch selection,
              the 15 baselines and the regression variant.
``data``      Dataset loaders and the simulated noisy user.
``utils``     Configs, metrics (AP, recall@k), checkpoints, JSONL logging
              and timers.
``round``     One full feedback round.
``graphs``    The captured CUDA graphs of the round's programs (the
              reference's ``jax.jit``).
``parallel``  The corpus-sharded mesh on ``torch.distributed``: sharded
              rounds, fused sessions and cohorts, the mesh-sharded session.
``runner``    The experiment harness (MAP-vs-rounds); ``cli`` its command line.
``serve``     The HTTP server, on one device or a mesh.
"""

__version__ = "0.1.0"
