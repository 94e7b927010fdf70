"""The port's tools: ``tsne`` (``main --tsne``, JAX ``tools/tsne.py``) and the
measurement tools that run on the card (``profile_*``, ``*_variants``)."""
