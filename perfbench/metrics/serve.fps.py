"""Frames whose labels reached host memory inside the measured window,
over the window's length: the window's rate of a host-bound serving cell,
whose runs spread too widely by process to hold it under an end-to-end
bound."""


def read(rec):
    return rec.e2e.get("serve_fps") if rec.kind == "serve" else None
