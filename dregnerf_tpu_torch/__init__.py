"""PyTorch + CUDA port of dregnerf_tpu for NVIDIA Hopper.

The JAX package `dregnerf_tpu` is the reference; this package mirrors its
layout module for module and never imports it (nor JAX). Entry points run
on the CUDA device unless the caller passes ``device="cpu"``
(see `dregnerf_tpu_torch.device`).
"""
