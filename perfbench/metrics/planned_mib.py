"""The engine's planned bytes (``memory_report``): the decode step's
activation arena plus the state plan, in MiB."""


def read(run):
    if not run.planned_bytes:
        return None
    return run.planned_bytes / 2**20
