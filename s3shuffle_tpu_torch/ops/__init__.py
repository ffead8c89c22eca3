"""Device operations of the port: CRC (K1), TLZ encode plane decisions (K2)
and the fused TLZ decode + CRC (K3), each a hand-written CUDA kernel beside
its plain PyTorch version, plus the PyTorch stages around them."""
