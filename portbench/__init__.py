"""The benchmark of graph_embed_tpu_torch (see harness.py)."""
