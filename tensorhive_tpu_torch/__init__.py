"""tensorhive_tpu_torch: the PyTorch + CUDA port of ``tensorhive_tpu``'s
device side, for NVIDIA Hopper (H100, ``sm_90a``).

The JAX package stays the reference; this package sits beside it, keeps its
module names (``models/``, ``ops/``, ``serving/``, ``core/services/``) and
its public tensor layouts, and imports nothing of it — not even its
jax-free modules, which are copied here where needed.

What it covers:

* serving: ``build_engine`` -> ``SlotEngine`` on the paged cache (bf16/f32
  or int8 pages), whole-prompt prefill through the hand-written
  flash-forward kernel (``csrc/flash_fwd.cu``) and decode through the
  hand-written paged-attention kernel (``csrc/paged_decode.cu``), with the
  prefix cache, the speculative lane, host KV-page tiering, deadlines,
  Retry-After estimates and a fault-injection plan; and the serving mesh
  (``parallel/``: dp x tp over ``torch.distributed``, rank 0 the
  controller, the kernels on each rank's head shard);
* training on one device: ``TransformerLM.loss`` -> ``train.make_train_step``
  -> ``train.train_loop``, attention differentiated through the
  hand-written flash-backward kernels (``csrc/flash_bwd.cu``);
* training on a ``pp x dp x fsdp x tp x sp`` mesh (``parallel/``: ring
  attention over sp, the GPipe pipeline over pp);
* the MLM encoder (``models/encoder``, attention through the head-blocked
  flash forward of ``csrc/flash_fwd.cu`` when ``flash_bh_block`` > 1) and
  LoRA fine-tuning (``models/lora``, on one device or a training mesh)
  through the same train step, fed by the token data pipeline (``data``);
  the int8 KV quality probe ``ops.kv_quant.sim_kv_loss``;
* the GPU host plane: the schema-v1 probe (``native/probe.cpp`` and an
  inline Python probe), ``core.monitors.GpuMonitor`` and the launch
  templates (``core/templates``, ``CUDA_VISIBLE_DEVICES``, ``torchrun``).

The kernels are built with ``nvcc`` at first use; on CPU tensors every
kernel wrapper runs its plain PyTorch version instead.

Entry points take ``device=None``, which means ``cuda`` and raises without
a CUDA device (``device.resolve_device``).
"""
from .device import resolve_device

#: the release this port tracks (the JAX package's ``__version__``)
__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]
