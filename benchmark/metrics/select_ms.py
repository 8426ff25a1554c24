"""Mean span of each call that returns batches (``next_batch_many`` or
``next_batch``), closed by the picks' read to the host."""


def read(rec):
    spans = rec.spans.get("select") or []
    return sum(spans) / len(spans) if spans else None
