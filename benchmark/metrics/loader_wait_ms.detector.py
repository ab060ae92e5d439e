"""Host ms a step that the trainer's batch iterator waits in ``next()`` on
the loader's feed (``data/loader.DataLoader`` through
``prefetch_to_device``), over the traced steps."""


def read(rec):
    if not rec.get("steps"):
        return None
    return rec["loader_wait_s"] * 1e3 / rec["steps"]
