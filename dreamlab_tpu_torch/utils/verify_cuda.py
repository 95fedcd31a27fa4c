"""Card smoke check before serving (the port's counterpart of
``dreamlab_tpu/utils/verify_tpu.py``): names the card, runs a bf16 matrix
product on it and reports its memory; no fallback to the CPU.

    python -m dreamlab_tpu_torch.utils.verify_cuda
"""

from __future__ import annotations

import sys
import time


def verify_cuda(verbose: bool = True) -> bool:
    def log(msg):
        if verbose:
            print(msg, flush=True)

    import torch

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device is available")
        return False
    name = torch.cuda.get_device_name(0)
    log(f"devices: {torch.cuda.device_count()} x {name}")
    try:
        x = torch.ones((512, 512), dtype=torch.bfloat16, device="cuda")
        t0 = time.time()
        y = x @ x
        checksum = float(y.float().sum())  # waits for the product
        log(f"matmul ok in {1e3 * (time.time() - t0):.0f} ms (checksum {checksum:.0f})")
        if checksum != 512.0 ** 3:
            log("FAIL: matmul checksum")
            return False
    except Exception as e:
        log(f"FAIL: matmul: {e}")
        return False
    free, total = torch.cuda.mem_get_info(0)
    log(f"memory: {(total - free) / 1e9:.2f} / {total / 1e9:.2f} GB used")
    log("PASS")
    return True


if __name__ == "__main__":
    sys.exit(0 if verify_cuda() else 1)
