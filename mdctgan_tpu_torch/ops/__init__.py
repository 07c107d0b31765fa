"""Port of mdctgan_tpu.ops."""
