"""PyTorch + CUDA port of graph_recsys_benchmark_tpu for one NVIDIA H100.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name and structure so each piece can be found and held
against it.  This package imports neither JAX nor anything of the JAX
package: what it needs of the JAX package's jax-free modules (the HIN
builders) is copied.

It covers PEAGAT, PEAGCN and PEASage (``PEAConfig.conv``), inference and
training: ``trainer = train.pea_trainer.PEATrainer(hin, cfg, tcfg)``, then
``params = trainer.init(seed)``, ``opt = trainer.optimizer(params)``,
``trainer.run_epoch(params, opt, generator)`` (BPR + the entity-aware
regularizer, Adam) and ``trainer.evaluate(params, generator)``.  PEAGAT
runs the hybrid GAT plan: the step-1 union graph through
``ops/flash_gat`` and the step-2 shared-edge groups through
``ops/batch_gat``; at the ML-25M scale (``metapath_edges=
data.movielens.ml25m_metapath_edges(hin)``) the grouped per-channel
forward: the large graphs' implicit self-loops through ``ops/stream_gat``
and the rest through the composed ``nn/conv.gat_apply``.  PEAGCN and
PEASage run one union graph a step: a row gather (``ops/gather``) and a
segment-sum (``ops/segment_kernels``).  The forwards and backwards of all
of them are CUDA kernels in ``csrc/`` (built with nvcc at first use,
``ops/_cuda.py``).  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; the plain PyTorch versions of
the kernels serve CPU tensors only.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
