"""chip_smoke.py's phase 4p (``parallel_phase``) rehearsed on the CPU: two
gloo rank processes, spawned once, run ``ring_prefill`` (sp 2, causal and
not) against a dense attention, ``pipeline_apply`` (pp 2) against the
sequential scan and moe-tiny decode steps with the experts over ep 2
against the unsharded step, in float32 at ``PAR_CPU``'s sizes; exchanges
and bytes as the schedules make them; attention launches 0 on both ranks
(the plain attention runs on the CPU). On the card the same phase runs at
llama-8b's attention and MLP widths and moe-wide whole (``PAR_CARD``)."""

from __future__ import annotations

import chip_smoke as C


def test_parallel_phase_on_the_cpu():
    st = C.parallel_phase("CPU", device="cpu", sizes=C.PAR_CPU)
    assert st["backend"] == "ep 2 x tp 1 over gloo (CPU ranks)"
    assert st["ring"]["causal"]["max_abs_err"] < 2e-5
    assert st["ring"]["non_causal"]["max_abs_err"] < 2e-5
    assert st["pipeline"]["max_abs_err"] <= 2e-5 * st["pipeline"]["ref_max_abs"]
    # The controls over a lost exchange leave the bounds.
    assert st["ring"]["causal"]["control_tol_ratio"] > 1.0
    assert st["ring"]["non_causal"]["control_tol_ratio"] > 1.0
    assert st["pipeline"]["control_max_abs_err"] > 2e-5 * st["pipeline"]["ref_max_abs"]
    assert st["ep"]["max_abs_err"] < 1e-4
    assert st["ep"]["launches"] == [0, 0]
    assert st["ep"]["experts"] == [[0, 2], [2, 4]]
    layers, steps = 2, C.PAR_CPU["ep"]["steps"]
    assert st["ep"]["collectives"] == {"all_reduce": layers * steps, "all_gather": 0,
                                       "ppermute": 0}
