"""torch.cuda.max_memory_allocated of the fullest card over the window
(after reset_peak_memory_stats at its start), in GiB."""


def read(rec):
    if not rec.device_peak_bytes:
        return None
    return rec.device_peak_bytes / 2**30
