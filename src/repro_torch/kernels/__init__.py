"""The model stack's kernels: B5 flash attention (``attention``), B6 the
Mamba2 SSD scan (``ssd``) and B7 the RG-LRU scan (``rglru``).  Each
wrapper launches its hand-written CUDA kernel (``csrc/model_kernels.cu``,
``csrc/ssm_kernels.cu``) on a CUDA tensor and runs its plain PyTorch
version on a CPU tensor."""
from repro_torch.kernels.attention import (  # noqa: F401
    flash_attention, flash_attention_kernel, flash_attention_plain)
from repro_torch.kernels.rglru import (  # noqa: F401
    rglru_scan, rglru_scan_plain)
from repro_torch.kernels.ssd import ssd_chunked, ssd_scan  # noqa: F401
