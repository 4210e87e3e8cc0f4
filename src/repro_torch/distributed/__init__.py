"""The distributed layer: name-driven sharding rules placed as
``DTensor``s (``sharding``) and GPipe over a stage axis
(``pipeline``)."""
