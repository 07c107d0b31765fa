"""Port of mdctgan_tpu.data."""
