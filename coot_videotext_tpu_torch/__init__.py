"""PyTorch/CUDA port of coot_videotext_tpu for one NVIDIA H100 (see README,
"PyTorch/CUDA port"). Imports torch, never jax, flax or coot_videotext_tpu."""
