"""opt_share.train: the share of the traced steps' device time spent in
the optimizer and the narrowing: operations launched inside AdamW
(`train_step`'s `adamw_update`, with the wide rounding it applies) or the
narrow copy (`train_step._narrow_copy`), marked by profiler ranges around
those program functions while the sub-window is traced."""
REGIONS = {"optimizer": ("repro_torch.train.train_step", "adamw_update"),
           "narrowing": ("repro_torch.train.train_step", "_narrow_copy")}


def read(r):
    t = r.trace
    if t is None or not t.device_s:
        return None
    return 100.0 * r.region_s(REGIONS) / t.device_s
