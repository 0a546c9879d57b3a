"""Integer arithmetic of the runtime-adaptive window climber.

Copy of ``repro/core/adaptive.py`` (plain Python ints, no device): the
parameter resolution (``window_cap_max``, ``resolve_climb``), the host twin
of one hill-climb update (``climb_update``) and the per-set window-way rule
(``window_set_ways``).  The device climb (``core/device_simulate.py``
``_climb_step``) and ``kernels/sketch_step.py`` ``rebalance`` run the same
arithmetic as tensor ops, so every rule here must stay equal to the
reference's; ``tests/test_torch_adaptive.py`` holds each function to it.

Resolved climb vector (``resolve_climb``), indices shared with
``_climb_step``:

    [0] delta0       initial / restart quota step (auto: wmax/16)
    [1] wmin         smallest window quota the climb may set (>= 1)
    [2] wmax         largest quota (auto: the adaptive table headroom)
    [3] tol          noise band on epoch-hit deltas (auto: epoch_len/256)
    [4] restart      |ehits - EWMA| beyond which the step re-expands
                     (auto: epoch_len/16)
    [5] warm_epochs  epochs that only seed the baselines (default 3)

Every ``//`` is Python's floor division, as ``jnp.int32 //`` is.
"""
from __future__ import annotations


def window_cap_max(capacity: int, window_cap: int,
                   window_max_frac: float) -> int:
    """Largest window quota the adaptive tables are sized for."""
    return max(window_cap,
               min(capacity - 1, int(round(capacity * window_max_frac))))


def resolve_climb(epoch_len: int, delta0: int, wmin: int, wmax: int,
                  tol: int, restart: int, warm_epochs: int,
                  cap_wmax: int) -> list[int]:
    """[delta0, wmin, wmax, tol, restart, warm_epochs] with zero fields
    auto-sized: delta0 = wmax/16, tol = epoch_len/256, restart =
    epoch_len/16."""
    wmax = min(wmax, cap_wmax) if wmax else cap_wmax
    d0 = delta0 or max(1, wmax // 16)
    tol = tol or max(1, epoch_len // 256)
    restart = restart or max(tol + 1, epoch_len // 16)
    return [d0, max(1, wmin), max(1, wmax), tol, restart,
            max(1, warm_epochs)]


def climb_update(climb: list[int], ehits: int, prev: int, dirn: int,
                 delta: int, ewma: int, trend: int, k: int, quota: int):
    """One epoch boundary of the hill climb in plain ints.

    Returns (new_quota, prev, dirn, delta, ewma, trend, k), line for line
    the update ``_climb_step`` makes on the card: a move beyond ``tol``
    against the drift ``trend`` keeps (improved) or reverses and halves
    (regressed) the step, a plateau decays it by 3/4 and holds still, a
    swing beyond ``restart`` re-expands it, warm epochs only follow the
    baselines, and the quota is clamped to [wmin, wmax].
    """
    d0, wmin, wmax, tol, restart, warm_epochs = climb
    diff = ehits - prev
    adiff = diff - trend
    improved = adiff > tol
    regressed = adiff < -tol
    trend_n = 0 if prev < 0 else trend + (diff - trend) // 4
    dirn_n = -dirn if regressed else dirn
    if regressed:
        delta_n = max(delta // 2, 1)
    elif improved:
        delta_n = delta
    else:
        delta_n = max((delta * 3) // 4, 1)
    shift = abs(ehits - ewma) > restart
    span4 = max(d0, (wmax - wmin) // 4)
    if shift:
        delta_n = min(max(delta_n, d0) * 2, span4) if improved else d0
    warm = k < warm_epochs
    ewma = ehits if (warm or prev < 0) else ewma + (ehits - ewma) // 4
    if not warm:
        dirn, delta, trend = dirn_n, delta_n, trend_n
    else:
        trend = 0 if prev < 0 else diff
    move = improved or regressed or shift
    step = 0 if (warm or not move) else dirn * delta
    nq = min(max(quota + step, wmin), wmax)
    if nq <= wmin:
        dirn = 1
    elif nq >= wmax:
        dirn = -1
    return nq, ehits, dirn, delta, ewma, trend, k + 1


def window_set_ways(quota: int, n_sets: int, load) -> list[int]:
    """Usable window ways per set for a runtime ``quota``.

    ``quota >= n_sets``: the uniform rule of the static padding (base ways
    everywhere, the first ``quota % n_sets`` sets one more), so a quota
    pinned at the configured split reproduces the static run.  Below
    ``n_sets``: one way to each of the ``quota`` sets with the most window
    traffic last epoch (``load``), ties to the lower set index.
    """
    quota, n_sets = int(quota), int(n_sets)
    if quota >= n_sets:
        base, rem = divmod(quota, n_sets)
        return [base + (1 if s < rem else 0) for s in range(n_sets)]
    order = sorted(range(n_sets), key=lambda s: (-int(load[s]), s))
    ways = [0] * n_sets
    for s in order[:quota]:
        ways[s] = 1
    return ways
