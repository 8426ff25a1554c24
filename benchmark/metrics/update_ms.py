"""Mean span of each call that absorbs feedback (``feedback_many`` or
``feedback``), closed by a device synchronization."""


def read(rec):
    spans = rec.spans.get("update") or []
    return sum(spans) / len(spans) if spans else None
