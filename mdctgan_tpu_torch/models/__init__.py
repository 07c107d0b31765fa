"""Port of mdctgan_tpu.models."""
