"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(:mod:`.ref`), the nvcc build (:mod:`.build`) and the dispatching wrappers
(:mod:`.ops`)."""
