from .metrics import compute_psnr, compute_ssim

__all__ = ["compute_psnr", "compute_ssim"]
