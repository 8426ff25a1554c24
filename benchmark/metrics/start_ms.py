"""Mean span of a session start (``create_session`` then ``set_query``),
closed by a device synchronization."""


def read(rec):
    spans = rec.spans.get("start") or []
    return sum(spans) / len(spans) if spans else None
