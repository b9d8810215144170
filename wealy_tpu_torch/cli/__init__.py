"""Command-line entry points of the port: ``python -m wealy_tpu_torch.cli.main
{validate-data,evaluate}`` and the Whisper model loading of ``extract.py``."""
