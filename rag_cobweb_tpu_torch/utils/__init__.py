"""Host utilities: logging, profiling on ``torch.profiler``, the kernels'
build-directory cache and the tree's graphviz views."""
