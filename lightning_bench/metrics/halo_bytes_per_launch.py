"""Bytes that the program's ``collective:halo`` spans carry (a rank's halo
exchange) over the window's launches, in bytes a launch."""


def read(r):
    sent = [s["bytes"] for s in r.spans
            if s["name"] == "collective:halo" and s["bytes"] is not None]
    return sum(sent) / r.launches if sent and r.launches else None
