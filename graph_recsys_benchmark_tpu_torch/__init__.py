"""PyTorch + CUDA port of graph_recsys_benchmark_tpu for one NVIDIA H100.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name and structure so each piece can be found and held
against it.  This package imports neither JAX nor anything of the JAX
package: what it needs of the JAX package's jax-free modules (the HIN
builders) is copied.

It covers PEAGAT on the hybrid GAT plan, inference and training:
``trainer = train.pea_trainer.PEATrainer(hin, cfg, tcfg)``, then
``params = trainer.init(seed)``, ``opt = trainer.optimizer(params)``,
``trainer.run_epoch(params, opt, generator)`` (BPR + the entity-aware
regularizer, Adam) and ``trainer.evaluate(params, generator)``.  The
step-1 union graph runs through ``ops/flash_gat`` and the step-2
shared-edge groups through ``ops/batch_gat``; their forwards and backwards
are CUDA kernels in ``csrc/`` (built with nvcc at first use,
``ops/_cuda.py``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the plain PyTorch versions of the kernels serve CPU
tensors only.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
