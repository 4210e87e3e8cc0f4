"""Percipience — the telemetry→prediction→action loop (paper's title
claim; the SAGE follow-up's ADDB-driven self-optimisation goal).

Data flow:

    ADDB records ─┐
    read hook    ─┼→ FeatureExtractor ─→ heat_scores (CUDA heat scan)
    FDMI events  ─┘         │                  │
                            │                  └→ PercipientPolicy → HsmDaemon
                            └→ transition matrix → markov_predict → Prefetcher

``attach_percipience(clovis)`` wires the whole loop onto a Clovis stack;
heat scoring runs on the stack's ``device``.
"""
from repro_torch.percipience.advisor import PercipientPolicy  # noqa: F401
from repro_torch.percipience.heat import (heat_scan,  # noqa: F401
                                          heat_scan_plain, heat_scores,
                                          heat_scores_ref, markov_predict,
                                          markov_topk)
from repro_torch.percipience.prefetcher import Prefetcher  # noqa: F401
from repro_torch.percipience.telemetry import FeatureExtractor  # noqa: F401


def attach_percipience(clovis, *, byte_budget: int = 64 << 20,
                       half_life_s: float = 120.0, sync: bool = False,
                       **prefetch_kw):
    """Wire extractor + prefetcher + percipient HSM scorer onto a Clovis
    stack.  Returns (extractor, prefetcher, policy)."""
    extractor = FeatureExtractor().attach(clovis.store)
    prefetcher = Prefetcher(clovis.store, extractor,
                            byte_budget=byte_budget, sync=sync,
                            **prefetch_kw).attach()
    policy = PercipientPolicy(extractor, half_life_s=half_life_s,
                              device=clovis.device)
    return extractor, prefetcher, policy
