"""``repro_torch.timing``: the address-level timing engine, the second oracle.

Counterpart of :mod:`repro.timing`. The replay of every interval of a run
is one launch of the Hopper kernel ``csrc/timing_replay.cu``
(:mod:`repro_torch.kernels.timing_replay`) on the card; the event streams
are built there in torch, bit-identical to the JAX package's numpy ones.

Why a second clock
------------------
The interval cost model (``repro_torch.sim.costmodel``) is the simulator's
clock: a roofline formula fed by per-interval aggregates. It inherits
the paper's stated limitation — the microbenchmark spreads accesses
evenly, so the model predicts *best-case* memory performance, and the
application-vs-microbenchmark gap is precisely what bounds the Table 2
model error. Until now the repo could only measure that gap against the
model itself. This package is an independent oracle in the tracehm
mold: it expands each interval into a deterministic stream of memory
events and replays them against per-tier channels (``avail_cycle``
bandwidth occupancy), per-access read/write latencies, a bounded MLP
in-flight window, per-page dependence chains, and an LLC absorption
front-end — producing *realized* per-interval times comparable 1:1 with
``IntervalCosts``.

Clock semantics
---------------
Both clocks share the physics constants (one ``HardwareProfile``), the
workload trace, and — by deterministic re-execution, not by state
sharing — the exact migration schedule. They differ only in how the
memory term is composed: aggregate roofline versus event replay. The
timing engine must stay oracle-independent: analysis rule TUNA010, and
``tests/test_torch_import_hygiene.py`` for the port, check that nothing
under ``repro_torch/timing/`` imports the interval engine, the sweeps or
the device step (``repro_torch.sim.engine``, ``.sim.sweep``,
``.sim.torch_engine``), or reads wall clocks (replays are seeded).

Calibration flow
----------------
:func:`repro_torch.timing.calibrate.calibrate` replays steady-state intervals
from the perfdb's own microbenchmark generator on fixed single-tier
placements and fits one latency scale and one bandwidth scale per tier
so the engine reproduces the analytic best case on even-spread streams.
Fit residuals ride along in the calibration object and are asserted
small by the fidelity benchmark's contract.

Interpreting divergence
-----------------------
After calibration, agreement on microbenchmark streams is by
construction, so divergence on an application trace isolates the model
error mechanism per regime: skewed participation serializes per-page
chains the roofline can only proxy through the participation ratio
(divergence concentrates here, per the paper); write-heavy traces
expose the slow tier's asymmetric write path, which the read-modeled
roofline ignores; migration-heavy intervals stress the shared-channel
contention assumptions. ``benchmarks/fig_model_fidelity.py`` reports
divergence per regime across every registered workload and the fm-frac
vector, and ``table2_accuracy`` carries a model-fidelity column.

Entry points: :func:`repro_torch.timing.runner.timing_runner` (a
``Scenario.runner`` plug-in — zero planner changes),
:class:`repro_torch.timing.engine.AddressTimingEngine` (direct replay),
:func:`repro_torch.timing.calibrate.calibrate`.
"""

from repro_torch.timing.calibrate import TimingCalibration, calibrate
from repro_torch.timing.engine import AddressTimingEngine, TimedInterval
from repro_torch.timing.latency import TimingParams, absorb_llc
from repro_torch.timing.runner import PAYLOAD_PROTOCOL, timing_runner
from repro_torch.timing.translate import TranslationTable

__all__ = [
    "AddressTimingEngine",
    "PAYLOAD_PROTOCOL",
    "TimedInterval",
    "TimingCalibration",
    "TimingParams",
    "TranslationTable",
    "absorb_llc",
    "calibrate",
    "timing_runner",
]
