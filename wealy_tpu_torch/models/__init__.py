"""Models of the port: Whisper (``whisper/``) and the projection heads that
turn stored Whisper embeddings into retrieval vectors."""
