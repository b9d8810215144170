"""Audio frontend: Whisper log-mel (plain PyTorch and the fused kernel K1)."""
