"""The plain reference of the benchmark's checks: float32 PyTorch (float64
for the audio front) with TF32 off, written from the published descriptions
of Whisper and of its front end. It imports neither JAX nor anything of the
program, and takes nothing that the program has made: it reads the same WAV
files and the same seeded state dict, and reads the program's outputs only
to judge them."""
