"""Work counts from shapes: the operations and bytes each kernel's function
needs (``kernels``), the model's FLOPs per input (``model``), and the
peaks they are held against (``PEAKS``).

The counts are of the algorithm, whatever implements it: each input byte
read once, each output byte written once, the products the function
needs.  So a share of a roofline or of a peak cannot pass 100 % after a
redesign of the kernel."""

#: NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
PEAKS = {
    "bf16_flop_per_s": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}
