"""The benchmark of gigagan_tpu_torch on one NVIDIA H100 (see BENCHMARK.json)."""
