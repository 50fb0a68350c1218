"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version and a launch counter (counterpart of :mod:`repro.kernels`).

CUDA sources live in ``repro_torch/csrc/`` and are built by
:mod:`repro_torch.kernels._build` at first CUDA use, never at import.
"""


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launch count in this process, by kernel name
    (the experiment API's fan-out reports what each job launched in its
    worker)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.page_migrate import migrate_pages
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.strided_probe import strided_probe
    from repro_torch.kernels.timing_replay import timing_replay
    from repro_torch.kernels.victim_partition import victim_partition
    from repro_torch.kernels.wkv6 import wkv6

    return {fn.__name__: fn.launches for fn in (
        victim_partition, migrate_pages, strided_probe, paged_decode_attention,
        flash_attention, wkv6, timing_replay)}
