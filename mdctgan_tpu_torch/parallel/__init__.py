"""Port of mdctgan_tpu.parallel."""
