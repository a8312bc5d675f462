"""Measuring tools of the PyTorch port: device timing and bounds
(``measure``) and the attention microbenchmark (``bench_attn_micro``)."""
