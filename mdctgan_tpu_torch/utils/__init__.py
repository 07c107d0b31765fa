"""Port of mdctgan_tpu.utils."""
