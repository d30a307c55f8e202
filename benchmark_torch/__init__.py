"""The PyTorch and CUDA port's benchmark (BENCHMARK.json at the checkout's root)."""
