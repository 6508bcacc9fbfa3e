"""PyTorch/CUDA port of longfellow_zk_tpu: the Longfellow ZK prover on an
NVIDIA H100 (sm_90a), with hand-written CUDA kernels under csrc/.

This package imports torch and numpy only; it never imports JAX or the
longfellow_zk_tpu package, whose host layers it carries as copies.
"""
