"""SAGE percipient-storage stack, the port's copy of the JAX-free core.

Layers, bottom-up (paper Fig. 2):
  tiers          — deep I/O hierarchy with device performance models
  object_store   — Mero analogue (blocks, containers, layouts, versions)
  transactions   — DTM: crash-atomic update groups (WAL + versioning)
  clovis         — access/index/management API on top of the store
  hsm            — usage-driven tier migration + RTHMS placement
  function_shipping — in-storage compute executors (torch builtins)
  addb           — telemetry

These modules are copies of ``repro.core``'s (imports rewritten, on-disk
formats unchanged), so the port opens a store the reference wrote.  HA,
FDMI plugins, storage windows and streams wait for later slices.
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
from repro_torch.core.tiers import (DeviceModel, TierDevice,  # noqa: F401
                                    TierPool, make_tier_pools)
from repro_torch.core.transactions import (Transaction,  # noqa: F401
                                           TransactionManager,
                                           WriteAheadLog)
