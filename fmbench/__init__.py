"""The benchmark of ``difacto_tpu_torch`` on one NVIDIA H100: see
fmbench/run.py and PERF.md."""
