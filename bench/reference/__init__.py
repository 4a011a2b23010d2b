"""Plain PyTorch references of the benchmark's models: ``plain.py`` runs
a layer table, and each architecture is a module here, named by its
configuration's ``reference`` key, whose ``layers(cfg)`` gives the table
and which may define its own ``forward`` in place of ``plain.forward``.
Nothing here imports the program under test or JAX."""
