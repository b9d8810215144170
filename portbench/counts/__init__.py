"""Operation and byte counts from shapes: one module for each kernel whose
roofline share the benchmark reports (``k2``, ``k3``) and one for the whole
model's FLOPs (``whisper``). They count what the algorithm needs, each input
byte read once and each output byte written once, whatever a kernel reads
again."""
