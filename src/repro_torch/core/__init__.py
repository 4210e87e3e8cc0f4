"""SAGE percipient-storage stack, the port's copy of the JAX-free core.

Layers, bottom-up (paper Fig. 2):
  tiers          — deep I/O hierarchy with device performance models
  object_store   — Mero analogue (blocks, containers, layouts, versions)
  transactions   — DTM: crash-atomic update groups (WAL + versioning)
  clovis         — access/index/management API on top of the store
  hsm            — usage-driven tier migration + RTHMS placement
  function_shipping — in-storage compute executors (torch builtins)
  storage_window — PGAS I/O (MPI storage windows analogue)
  streams        — MPIStream analogue (I/O offload)
  addb           — telemetry

These modules are copies of ``repro.core``'s (imports rewritten, on-disk
formats unchanged), so the port opens a store the reference wrote.  HA
and FDMI plugins wait for later slices.

One layer lives above this package: repro_torch.percipience closes the
telemetry→prediction→action loop (heat scoring on the card, prefetch,
learned tier placement); its names are re-exported here lazily (PEP 562)
so ``from repro_torch.core import Prefetcher`` works without an import
cycle.
"""
from repro_torch.core.addb import Addb, GLOBAL_ADDB  # noqa: F401
from repro_torch.core.clovis import (Clovis, ClovisIndex,  # noqa: F401
                                     open_reference_store)
from repro_torch.core.function_shipping import (FunctionShipper,  # noqa: F401
                                                PartialAgg, ShipResult)
from repro_torch.core.hsm import (CountingScorer, HsmDaemon,  # noqa: F401
                                  HsmPolicy, recommend_tier)
from repro_torch.core.layouts import Layout, DEFAULT_LAYOUTS  # noqa: F401
from repro_torch.core.object_store import ObjectStore  # noqa: F401
from repro_torch.core.storage_window import (MemoryWindow,  # noqa: F401
                                             StorageWindow, WindowAllocator)
from repro_torch.core.streams import (StreamBackpressureError,  # noqa: F401
                                      StreamContext, StreamTap,
                                      clovis_appender, tee)
from repro_torch.core.tiers import (DeviceModel, TierDevice,  # noqa: F401
                                    TierPool, make_tier_pools)
from repro_torch.core.transactions import (Transaction,  # noqa: F401
                                           TransactionManager,
                                           WriteAheadLog)

_PERCIPIENCE_NAMES = ("FeatureExtractor", "Prefetcher", "PercipientPolicy",
                      "attach_percipience", "heat_scores", "markov_predict")


def __getattr__(name):
    # lazy re-export: repro_torch.percipience imports repro_torch.core
    # submodules, so an eager import here would cycle
    if name in _PERCIPIENCE_NAMES:
        import repro_torch.percipience as _p
        return getattr(_p, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute "
                         f"{name!r}")
