"""The benchmark of ``repro_torch``: top-k discovery queries sent through
``repro_torch.service.DiscoveryService`` on one card, with outputs checked
against a plain NumPy reference.  ``nuribench/run.py`` runs one cell."""
