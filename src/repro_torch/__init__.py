"""Tuna on PyTorch and CUDA: the port of :mod:`repro` to one NVIDIA GPU.

The package mirrors the layout of the JAX package so that each module's
counterpart is easy to find (``repro_torch.sim.api`` <- ``repro.sim.api``,
and so on). It imports ``torch`` and numpy only: nothing of JAX and nothing
of the ``repro`` package, whose pieces it needs are copied here.

Entry points run on the card by default (``device=None`` means ``"cuda"``
and raises when no GPU is present); the CPU is used only when the caller
passes ``device="cpu"``. On a CUDA tensor every kernel wrapper launches its
hand-written kernel or raises; on a CPU tensor it takes the kernel's plain
PyTorch version, which is what the CPU tests compare against the JAX
package.

Ported so far: the Tuna sweep loop (trace -> TPP policy step on the card,
with the ``victim_partition`` CUDA kernel -> cost model -> telemetry ->
performance database -> tuner -> watermarks, through
:func:`repro_torch.sim.api.run`), and the tiered KV serving loop
(:mod:`repro_torch.serving`, HBM and pinned host pools, pages copied by the
``migrate_pages`` kernel), with the ``strided_probe`` and
``paged_decode_attention`` kernels behind their entry points in
:mod:`repro_torch.kernels`.
"""
