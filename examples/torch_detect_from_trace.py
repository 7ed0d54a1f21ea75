"""Framework-agnostic detection from a raw communication-call log — the
PyTorch port's twin of ``examples/detect_from_trace.py``.

This is FALCON-DETECT's tracking phase exactly as the paper describes it
(§4.2): the input is nothing but a sequence of (op_type, timestamp) events —
what the LD_PRELOAD shim logs — with no knowledge of the framework, model,
or parallelism strategy.

  1. ACF recovers the recurring period of the call pattern.
  2. Per-iteration times are derived from same-call timestamp deltas.
  3. BOCD + 10 % verification flags fail-slow onset and relief.

As in the reference, everything here is host work (the float64 BOCD of
``detect_slow_iterations``), so the twin takes no ``--device``.

Run:  PYTHONPATH=src python examples/torch_detect_from_trace.py
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.acf import iteration_times_from_events
from repro_torch.core.detector import detect_slow_iterations
from repro_torch.core.events import CommEvent, CommOp

# One training iteration issues this collective pattern (unknown to FALCON).
PATTERN = [CommOp.ALL_REDUCE, CommOp.SEND_RECV, CommOp.REDUCE_SCATTER,
           CommOp.ALL_GATHER, CommOp.SEND_RECV]
BASE_ITER = 1.8  # seconds
N_ITERS = 400


def synthesize_log(rng: np.random.Generator) -> list[CommEvent]:
    """A Monitor log: healthy -> congested (1.45x) at iter 150 -> recovered
    at iter 280."""
    phases = np.sort(rng.uniform(0.05, 0.9, size=len(PATTERN)))
    events, t = [], 0.0
    for i in range(N_ITERS):
        it = BASE_ITER * float(rng.normal(1.0, 0.01))
        if 150 <= i < 280:
            it *= 1.45
        offs = np.sort(phases * it + rng.normal(0, 2e-3, size=len(PATTERN)))
        events += [CommEvent(op=op, timestamp=t + o)
                   for op, o in zip(PATTERN, offs, strict=True)]
        t += it
    return events


def main() -> None:
    rng = np.random.default_rng(42)
    events = synthesize_log(rng)
    print(f"monitor log: {len(events)} communication calls, op types "
          f"{sorted({e.op.value for e in events})}")

    iter_times, period = iteration_times_from_events(events)
    print(f"ACF period: {period} calls/iteration "
          f"(ground truth {len(PATTERN)})")
    print(f"estimated healthy iteration: {np.median(iter_times[:100]):.3f}s "
          f"(ground truth {BASE_ITER:.3f}s)")

    cps = detect_slow_iterations(np.asarray(iter_times), hazard=1 / 100.0)
    print("\nconfirmed change-points:")
    for cp in cps:
        kind = "onset " if cp.relative_change > 0 else "relief"
        print(f"  iter {cp.index:>4}: {kind} {cp.mean_before:.2f}s -> "
              f"{cp.mean_after:.2f}s ({cp.relative_change:+.1%})")

    assert period == len(PATTERN)
    assert any(cp.relative_change > 0.3 for cp in cps), "onset missed"
    assert any(cp.relative_change < -0.2 for cp in cps), "relief missed"
    print("\ndetect_from_trace OK")


if __name__ == "__main__":
    main()
