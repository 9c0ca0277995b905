"""Evaluation metrics (the port of ``r2dm_tpu/metrics``): BEV histogram JSD
and MMD on tensors (``bev``), Fréchet distance and feature MMD on the host
(``distribution``), and the feature extractors (``extractor``)."""
