"""Models of the port (Whisper for now)."""
