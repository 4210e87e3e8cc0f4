"""Launchers and tools of the port: ``train`` (on one device or a
``data x model`` mesh), ``serve`` (batched prefill + greedy decode),
``mesh`` (device meshes), ``analysis`` (the roofline) and ``dryrun``
(every arch x shape x mesh cell on a fake process group)."""
