"""Resilient edge ingestion — surviving hostile real-world producers.

SAGE's premise is immense data arriving from "large, dispersed
scientific instruments and sensors" that the storage system ingests
and processes in place (paper §1, §4.2).  PR 4's continuous queries
assumed well-behaved in-process producers; this package is the armour
for real ones:

    instrument ──▶ EdgeBuffer (durable, checksummed, replayable WAL)
                      │ crash? replay()
                      ▼
                 EdgeIngestor ──▶ IdempotencyLedger (dedup: replays and
                      │            redeliveries never double-count)
                      ├──poison──▶ DeadLetterQueue (routed, ADDB-visible)
                      ├──full────▶ StreamBackpressureError (typed, loud)
                      ▼
                 StreamContext ──▶ continuous queries (exactly-once
                                   window aggregates, byte-identical to
                                   batch recomputation — the chaos
                                   gauntlet's invariant)

Entry points: ``EdgeBuffer(dir)`` + ``EdgeIngestor(ctx, buffer,
producer=p)``; see docs/ingestion.md and examples/edge_tour.py.

These modules are the port's copies of ``repro.edge``'s, with only their
imports rewritten: segment files are the reference's byte for byte, so
either package replays a buffer the other wrote.
"""
from repro_torch.edge.buffer import (EdgeBuffer,  # noqa: F401
                                     EdgeBufferCorruption, EdgeRecord)
from repro_torch.edge.ingest import (APPLIED, DUPLICATE,  # noqa: F401
                                     POISON, DeadLetter, DeadLetterQueue,
                                     EdgeIngestor, decode_array,
                                     encode_array)
from repro_torch.edge.ledger import IdempotencyLedger  # noqa: F401
