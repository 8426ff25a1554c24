"""Batches returned to users over the window's seconds."""


def read(rec):
    return rec.batches / rec.window_s if rec.window_s > 0 else None
