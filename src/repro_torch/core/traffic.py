"""Serving-traffic request streams (the aggregate-workload generator; the
reference's ``repro/core/traffic.py``, numpy only, unchanged).

The paper tunes the movement period against one application's reuse; a
serving system sees a *mix* of requests arriving over time, each with its
own prompt length, output budget and KV access pattern.  This module
generates those streams: Poisson arrivals per decode step, mixed
prompt/output lengths, and a per-request workload ``kind`` naming the
access pattern (resolved by the consumer -- ``serve.sched`` maps kinds
onto ``memtier.workload`` mass generators).

``poisson_request_stream`` generates one stationary phase; concatenate
calls with different rates/mixes (``shifting_mix_stream``) to model the
traffic-mix shifts the online tuner must survive.

The **hostile suite** generates the adversarial shapes a permanently-on
tuner has to survive (ARMS / Hybrid Adaptive Tuning, PAPERS.md), all
built on one modulated-Poisson kernel and all phase-composable through
``shifting_mix_stream``:

  * ``flash_crowd_stream``   -- the arrival rate spikes x ``spike_factor``
    for short bursts (a viral prompt, a retry storm);
  * ``diurnal_stream``       -- a smooth sinusoidal rate swing (the
    day/night cycle compressed to decode steps);
  * ``correlated_burst_stream`` -- arrivals come in correlated clumps of
    ``burst_size`` (webhook fan-out, batch clients): the mean rate is
    preserved but the variance is ``burst_size`` x Poisson;
  * ``mix_inversion_stream`` -- the kind-mix abruptly inverts every
    ``invert_every`` steps (``invert_kinds``), so the dominant access
    pattern flips without the rate changing at all.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["RequestSpec", "poisson_request_stream",
           "modulated_request_stream", "flash_crowd_stream",
           "diurnal_stream", "correlated_burst_stream",
           "mix_inversion_stream", "invert_kinds", "shifting_mix_stream"]


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One request of a traffic stream (all lengths in tokens/steps)."""

    rid: int
    arrival: int                  # decode step the request arrives at
    prompt_len: int
    new_tokens: int               # output budget (retire on length)
    kind: str                     # access-pattern name (consumer-resolved)
    seed: int

    def total_tokens(self, prefix_len: int = 0) -> int:
        return prefix_len + self.prompt_len + self.new_tokens

    def n_pages(self, page_size: int, prefix_len: int = 0) -> int:
        """KV pages the request occupies (page-aligned allocation)."""
        return -(-self.total_tokens(prefix_len) // page_size)


def modulated_request_stream(steps: int,
                             rate: Union[float, Callable[[int], float]],
                             kinds: Union[Dict[str, float],
                                          Callable[[int], Dict[str, float]]],
                             *, burst_size: int = 1,
                             prompt_len: Tuple[int, int] = (16, 64),
                             new_tokens: Tuple[int, int] = (32, 128),
                             start: int = 0, rid0: int = 0,
                             seed: int = 0) -> List[RequestSpec]:
    """The kernel every stream generator is built on: per decode step,
    ``Poisson(rate(t) / burst_size)`` arrival *events* fire, each bringing
    ``burst_size`` requests at once (``burst_size=1`` is plain Poisson;
    larger values keep the mean rate but clump arrivals into correlated
    bursts).  ``rate`` and ``kinds`` may be constants or per-step
    callables of the phase-local step index.  Arrivals are offset by
    ``start`` and request ids by ``rid0`` so phases concatenate cleanly;
    the draw sequence is deterministic given ``seed``."""
    rng = np.random.default_rng(seed)
    rate_fn = rate if callable(rate) else (lambda t, _r=float(rate): _r)
    kinds_fn = kinds if callable(kinds) else (lambda t, _k=dict(kinds): _k)
    burst_size = max(1, int(burst_size))
    specs: List[RequestSpec] = []
    rid = rid0
    for t in range(steps):
        k = kinds_fn(t)
        names = sorted(k)
        w = np.asarray([k[n] for n in names], np.float64)
        w = w / w.sum()
        lam = max(0.0, float(rate_fn(t))) / burst_size
        for _ in range(int(rng.poisson(lam)) * burst_size):
            specs.append(RequestSpec(
                rid=rid, arrival=start + t,
                prompt_len=int(rng.integers(prompt_len[0],
                                            prompt_len[1] + 1)),
                new_tokens=int(rng.integers(new_tokens[0],
                                            new_tokens[1] + 1)),
                kind=names[int(rng.choice(len(names), p=w))],
                seed=int(rng.integers(0, 2 ** 31 - 1))))
            rid += 1
    return specs


def poisson_request_stream(steps: int, rate: float,
                           kinds: Dict[str, float], *,
                           prompt_len: Tuple[int, int] = (16, 64),
                           new_tokens: Tuple[int, int] = (32, 128),
                           start: int = 0, rid0: int = 0,
                           seed: int = 0) -> List[RequestSpec]:
    """One stationary traffic phase: per decode step, ``Poisson(rate)``
    requests arrive; each draws its kind from the ``kinds`` weight map and
    its prompt/output lengths uniformly from the given inclusive ranges.
    Arrivals are offset by ``start`` and request ids by ``rid0`` so phases
    concatenate cleanly."""
    return modulated_request_stream(steps, rate, kinds,
                                    prompt_len=prompt_len,
                                    new_tokens=new_tokens, start=start,
                                    rid0=rid0, seed=seed)


def flash_crowd_stream(steps: int, rate: float, kinds: Dict[str, float], *,
                       spike_factor: float = 8.0, spike_every: int = 200,
                       spike_len: int = 12, spike_offset: int = 0,
                       prompt_len: Tuple[int, int] = (16, 64),
                       new_tokens: Tuple[int, int] = (32, 128),
                       start: int = 0, rid0: int = 0,
                       seed: int = 0) -> List[RequestSpec]:
    """Flash crowds: the base ``rate`` spikes x ``spike_factor`` for
    ``spike_len`` steps every ``spike_every`` steps (first spike at
    ``spike_offset``) -- the short hostile burst that poisons a TRIAL
    window mid-sweep if the tuner has no guardrail."""
    spike_every = max(1, int(spike_every))

    def rate_fn(t: int) -> float:
        return rate * (spike_factor
                       if (t - spike_offset) % spike_every < spike_len
                       and t >= spike_offset else 1.0)

    return modulated_request_stream(steps, rate_fn, kinds,
                                    prompt_len=prompt_len,
                                    new_tokens=new_tokens, start=start,
                                    rid0=rid0, seed=seed)


def diurnal_stream(steps: int, rate: float, kinds: Dict[str, float], *,
                   swing_period: int = 400, amplitude: float = 0.8,
                   phase: float = 0.0,
                   prompt_len: Tuple[int, int] = (16, 64),
                   new_tokens: Tuple[int, int] = (32, 128),
                   start: int = 0, rid0: int = 0,
                   seed: int = 0) -> List[RequestSpec]:
    """Diurnal swing: the arrival rate follows
    ``rate * (1 + amplitude * sin(2*pi*(t/swing_period + phase)))`` -- a
    smooth but large load oscillation (peak/trough ratio
    ``(1+a)/(1-a)``) that a drift detector tuned for step changes must
    ride out without churning through re-profiles."""
    swing_period = max(1, int(swing_period))

    def rate_fn(t: int) -> float:
        return rate * (1.0 + amplitude
                       * math.sin(2.0 * math.pi * (t / swing_period + phase)))

    return modulated_request_stream(steps, rate_fn, kinds,
                                    prompt_len=prompt_len,
                                    new_tokens=new_tokens, start=start,
                                    rid0=rid0, seed=seed)


def correlated_burst_stream(steps: int, rate: float,
                            kinds: Dict[str, float], *,
                            burst_size: int = 6,
                            prompt_len: Tuple[int, int] = (16, 64),
                            new_tokens: Tuple[int, int] = (32, 128),
                            start: int = 0, rid0: int = 0,
                            seed: int = 0) -> List[RequestSpec]:
    """Correlated bursts: arrivals clump into groups of ``burst_size``
    (Poisson arrival *events* at ``rate / burst_size``), preserving the
    mean rate while multiplying the arrival variance by ``burst_size`` --
    the heavy-tailed load shape that de-noises a fixed-length trial
    window into a wrong ranking."""
    return modulated_request_stream(steps, rate, kinds,
                                    burst_size=burst_size,
                                    prompt_len=prompt_len,
                                    new_tokens=new_tokens, start=start,
                                    rid0=rid0, seed=seed)


def invert_kinds(kinds: Dict[str, float]) -> Dict[str, float]:
    """Invert a kind-weight map: the weight vector is reversed across the
    sorted kind names, so the dominant kind becomes the rarest and vice
    versa (a pure mix inversion -- total weight, and hence the arrival
    rate, is unchanged)."""
    names = sorted(kinds)
    weights = [kinds[n] for n in names]
    return dict(zip(names, reversed(weights)))


def mix_inversion_stream(steps: int, rate: float, kinds: Dict[str, float],
                         *, invert_every: int = 300,
                         prompt_len: Tuple[int, int] = (16, 64),
                         new_tokens: Tuple[int, int] = (32, 128),
                         start: int = 0, rid0: int = 0,
                         seed: int = 0) -> List[RequestSpec]:
    """Abrupt kind-mix inversions: every ``invert_every`` steps the kind
    mix flips between ``kinds`` and ``invert_kinds(kinds)`` with no rate
    change at all -- the access-pattern phase change arrives silently in
    the reuse structure, not in the load level."""
    invert_every = max(1, int(invert_every))
    flipped = invert_kinds(kinds)

    def kinds_fn(t: int) -> Dict[str, float]:
        return flipped if (t // invert_every) % 2 else kinds

    return modulated_request_stream(steps, rate, kinds_fn,
                                    prompt_len=prompt_len,
                                    new_tokens=new_tokens, start=start,
                                    rid0=rid0, seed=seed)


#: Per-phase generators ``shifting_mix_stream`` can dispatch to via the
#: optional 4th phase element ``{"gen": <name>, ...kwargs}``.
PHASE_GENERATORS: Dict[str, Callable[..., List[RequestSpec]]] = {
    "poisson": poisson_request_stream,
    "flash_crowd": flash_crowd_stream,
    "diurnal": diurnal_stream,
    "burst": correlated_burst_stream,
    "inversion": mix_inversion_stream,
}


def shifting_mix_stream(phases: Sequence[Tuple], *,
                        prompt_len: Tuple[int, int] = (16, 64),
                        new_tokens: Tuple[int, int] = (32, 128),
                        seed: int = 0) -> List[RequestSpec]:
    """Concatenate stationary phases ``(steps, rate, kind_weights)`` into
    one stream whose arrival mix shifts at each phase boundary -- the
    workload the scheduler-fed online tuner is benchmarked against.

    A phase may carry an optional 4th element, a dict of generator
    kwargs: ``{"gen": "flash_crowd", "spike_factor": 8.0, ...}`` routes
    the phase through the named hostile generator (``PHASE_GENERATORS``)
    instead of plain Poisson, which is how the hostile suite composes
    with ordinary mix-shift phases in one stream."""
    specs: List[RequestSpec] = []
    startt = 0
    for i, ph in enumerate(phases):
        steps, rate, kinds = ph[0], ph[1], ph[2]
        extra = dict(ph[3]) if len(ph) > 3 else {}
        gen = PHASE_GENERATORS[extra.pop("gen", "poisson")]
        specs.extend(gen(steps, rate, kinds, prompt_len=prompt_len,
                         new_tokens=new_tokens, start=startt,
                         rid0=len(specs), seed=seed + 7919 * i, **extra))
        startt += steps
    return specs
