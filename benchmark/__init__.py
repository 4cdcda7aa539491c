"""The benchmark of the PyTorch port (``rcgan_tpu_torch``): its harness,
configurations, cells, per-layer metrics, plain references and work
counts.  ``python3 -m benchmark.run --help`` runs one cell."""
