"""sheeprl_tpu_torch: the PyTorch/CUDA port of sheeprl_tpu for NVIDIA Hopper.

The package sits beside the JAX package and imports nothing of it. Importing
it loads no algorithm: the serve verb imports a family's module when that
family is served. See ``python -m sheeprl_tpu_torch serve --help``.
"""

__version__ = "0.1.0"
