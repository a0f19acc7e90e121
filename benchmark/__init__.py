"""The benchmark of ``fastslam_tpu_torch``: ``python3 -m benchmark.run``."""
