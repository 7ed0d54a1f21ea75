"""What FALCON must report while it watches a training cell's modelled job,
worked out from the traffic's fail-slow trace and the watched job alone, and
the departures from it in the events a run reported.

The trace's first episode slows one GPU from its ``start`` (in healthy
iterations of the watched job) until the next episode begins; no run reaches
that one. FALCON's answer to it, as the paper describes it:

* one diagnosis, at or after the onset and within the traffic's
  ``diagnosis_within`` iterations of it, of a GPU degradation naming that
  GPU alone;
* mitigation up the ladder for a computation fail-slow: first S1 (ignore),
  then, when it escalates, S2 (move micro-batches between data-parallel
  groups); within ``escalation_within`` iterations of the onset where the
  traffic states it;
* an S2 plan keeps the job's micro-batches and gives the slow GPU's
  data-parallel group the fewest, fewer than an even share. Ranks are
  ordered tensor-parallel innermost, then data-parallel, then stage, so
  GPU ``g`` is in group ``(g // tp) % dp``.

Events are plain dicts in the order they were reported: ``type``, ``time``
(seconds of the modelled job's clock), and for a ``Diagnosis`` its
``cause`` and ``components``, for a ``MitigationResult`` its ``strategy``,
``applied``, ``status``, ``kind`` and ``allocation``.
"""
from __future__ import annotations

import math

LADDER = ("IGNORE", "ADJUST_MICROBATCH")


def expected(traffic: dict, job: dict) -> dict:
    """FALCON's answer to the first episode of ``traffic``'s trace, on the
    watched job ``job`` (a configuration's ``deployment.watched_job``)."""
    episodes = sorted(traffic["injections"], key=lambda e: e["start"])
    first = episodes[0]
    if first["kind"] != "gpu" or len(first["target"]) != 1:
        raise ValueError(f"the first episode must slow one GPU: {first}")
    gpu = first["target"][0]
    exp = traffic["expect"]
    return {
        "onset": first["start"],
        "until": episodes[1]["start"] if len(episodes) > 1 else math.inf,
        "cause": "gpu_degradation",
        "components": [f"gpu:{gpu}"],
        "slow_group": (gpu // job["tp"]) % job["dp"],
        "groups": job["dp"],
        "micro_batches": job["micro_batches"],
        "diagnosis_within": exp["diagnosis_within"],
        "escalation_within": exp.get("escalation_within"),
    }


def _plan_faults(alloc, exp: dict) -> list[str]:
    if alloc is None or len(alloc) != exp["groups"]:
        return [f"S2 plan {alloc} has not one share per data-parallel group"]
    out = []
    if sum(alloc) != exp["micro_batches"]:
        out.append(f"S2 plan {alloc} does not keep {exp['micro_batches']} micro-batches")
    slow = alloc[exp["slow_group"]]
    others = [a for i, a in enumerate(alloc) if i != exp["slow_group"]]
    if not (slow < min(others) and slow * exp["groups"] < exp["micro_batches"]):
        out.append(f"S2 plan {alloc} does not give group {exp['slow_group']} the fewest")
    return out


def mismatches(events: list[dict], end: float, unit: float, exp: dict) -> list[str]:
    """Each way in which ``events`` depart from ``exp``, for a run whose
    modelled clock reached ``end`` seconds, ``unit`` seconds a healthy
    iteration. An expected event is due once the clock has passed its
    deadline; before that its absence is no fault."""
    onset, until = exp["onset"] * unit, exp["until"] * unit
    ours = [e for e in events if e["time"] < until]
    out = []
    diags = [e for e in ours if e["type"] == "Diagnosis"]
    for d in diags:
        if d["time"] < onset:
            out.append(f"diagnosis at {d['time']:.3f} s before the onset at {onset:.3f} s")
        if d["cause"] != exp["cause"] or list(d["components"]) != exp["components"]:
            out.append(f"diagnosis {d['cause']} {d['components']}, expected "
                       f"{exp['cause']} {exp['components']}")
    if len(diags) > 1:
        out.append(f"{len(diags)} diagnoses of one episode")
    due = (exp["onset"] + exp["diagnosis_within"]) * unit
    if end >= due and not any(d["time"] <= due for d in diags):
        out.append(f"no diagnosis by {due:.3f} s")
    results = [e for e in ours if e["type"] == "MitigationResult" and e["kind"] == "mitigate"]
    for i, r in enumerate(results):
        if r["strategy"] not in LADDER or (i == 0 and r["strategy"] != LADDER[0]):
            out.append(f"mitigation {i + 1} is {r['strategy']}; the ladder is {LADDER}")
        if not r["applied"] or r["status"] != "ok":
            out.append(f"mitigation {r['strategy']} not applied ({r['status']})")
        if r["strategy"] == LADDER[1]:
            out += _plan_faults(r["allocation"], exp)
    if exp["escalation_within"] is not None:
        due = (exp["onset"] + exp["escalation_within"]) * unit
        if end >= due and not any(r["strategy"] == LADDER[1] and r["time"] <= due
                                  for r in results):
            out.append(f"no S2 by {due:.3f} s")
    return out
