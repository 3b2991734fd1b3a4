"""Kernels and their wrappers.

* ``paged_attention``       — K1, decode attention over bf16/f32 pages;
* ``paged_attention_quant`` — K2, decode attention over int8/e4m3 pages;
* ``quantized_matmul``      — the shared quantization recipes;
* ``common``                — the CUDA/CPU device split;
* ``_build``                — builds ``csrc/*.cu`` with nvcc at first use.

Importing this package builds nothing and needs no card: a kernel is
compiled the first time a wrapper is called on a CUDA tensor.
"""
