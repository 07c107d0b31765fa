"""Port of mdctgan_tpu.train."""
