"""PyTorch/CUDA port of imagine360_tpu for one NVIDIA H100.

Mirrors the JAX package's module names (ops/, models/, geometry/,
diffusion/, pipeline/, native/, utils/, presets.py, config.py, cli.py). The
attention kernels are hand-written CUDA for sm_90a (csrc/, bound in
ops/kernels.py). Importing this package imports neither JAX nor the JAX
package.
"""
