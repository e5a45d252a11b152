"""Host-side sampling time grids (numpy).

Copy of `ops/time_grids.py` of the JAX package: the continuous VE/VP grid
and the DDPM (t, t_prev) pairs with the optional time-travel schedule.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["score_time_grid", "ddpm_time_pairs", "schedule_jump", "check_times"]


def score_time_grid(num_steps: int, eps: float) -> np.ndarray:
    """Continuous time grid for VE/VP models: linspace(1, eps, num_steps)."""
    return np.linspace(1.0, eps, num_steps, dtype=np.float64).astype(np.float32)


def check_times(times: List[int], t_0: int, num_steps: int) -> None:
    """Sanity checks on a jump schedule."""
    if not times[0] > times[1] or times[-1] != -1:
        raise ValueError(f"bad jump schedule ends: {times[:2]} ... {times[-1]}")
    for t_last, t_cur in zip(times[:-1], times[1:]):
        if abs(t_last - t_cur) != 1:
            raise ValueError(f"jump schedule skips from {t_last} to {t_cur}")
    for t in times:
        if not t_0 <= t <= num_steps:
            raise ValueError(f"jump schedule time {t} outside [{t_0}, {num_steps}]")


def schedule_jump(num_steps: int, travel_length: int, travel_repeat: int) -> List[int]:
    """Time-travel schedule for DDPM sampling; with travel_length ==
    travel_repeat == 1 it is num_steps-1, ..., 0, -1."""
    jumps = {}
    for j in range(0, num_steps - travel_length, travel_length):
        jumps[j] = travel_repeat - 1

    t = num_steps
    time_steps: List[int] = []
    while t >= 1:
        t = t - 1
        time_steps.append(t)
        if jumps.get(t, 0) > 0:
            jumps[t] = jumps[t] - 1
            for _ in range(travel_length):
                t = t + 1
                time_steps.append(t)
    time_steps.append(-1)
    check_times(time_steps, -1, num_steps)
    return time_steps


def ddpm_time_pairs(sde_num_steps: int, num_steps: int, travel_length: int = 1,
                    travel_repeat: int = 1,
                    early_stopping_pct: Optional[float] = None) -> np.ndarray:
    """(t, t-1) integer pairs scaled by skip = sde_num_steps // num_steps,
    shape (S, 2); t-1 = 0 maps to -1."""
    if sde_num_steps < num_steps:
        raise ValueError(f"{num_steps} steps exceed the SDE's {sde_num_steps}")
    skip = sde_num_steps // num_steps
    ts = schedule_jump(num_steps, travel_length, travel_repeat)
    pairs = [(i * skip, j * skip if j > 0 else -1) for i, j in zip(ts[:-1], ts[1:])]
    if early_stopping_pct is not None:
        pairs = pairs[: int(early_stopping_pct * len(pairs))]
    return np.asarray(pairs, dtype=np.int32)
