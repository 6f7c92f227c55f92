"""Framework-free helpers the port keeps its own copies of."""

from edl_tpu_torch.utils.retry import GiveUpError, RetryPolicy

__all__ = ["GiveUpError", "RetryPolicy"]
