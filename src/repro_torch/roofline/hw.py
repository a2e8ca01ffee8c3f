"""NVIDIA H100 SXM constants (per card) for the roofline model: the card
``nvidia-smi`` reports as "NVIDIA H100 80GB HBM3, 700.00 W".  Source: the
public NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column (dense rates,
without the sparsity factor)."""

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_F32 = 67e12        # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
NVLINK_BW = 900e9             # bytes/s a card, NVLink 4 (both directions)
CARD_HBM_BYTES = 80e9         # 80 GB of HBM3
