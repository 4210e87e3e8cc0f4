"""The training data pipeline: ``pipeline.py`` is the port's copy of
``repro.data.pipeline`` with only its imports rewritten, so the corpus
objects it writes are the reference's byte for byte.  Batches are numpy
arrays; the trainer moves them to its device."""
