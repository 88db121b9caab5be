"""Faults planted under a run's timed path, one function each: called
with the application's module (in every rank's process too), it breaks
what the timed path produces and returns the function that mends it; the
run's ``correct`` has to come out false."""

import torch


def _patch(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    return lambda: setattr(module, name, old)


def kmeans_state_unchanged(app):
    """Every launch hands back the centroids it was given."""
    return _patch(app, "kmeans_assign_reduce", lambda points, cen: (
        cen.clone(), torch.ones(cen.shape[0], device=cen.device)))


def kmeans_half_batch(app):
    """Half of the points left out, the mean taken over the rest."""
    real = app.kmeans_assign_reduce
    return _patch(app, "kmeans_assign_reduce", lambda points, cen: real(
        points[:points.shape[0] // 2], cen))


def kmeans_answer_altered(app):
    """One cluster's count off by one where the kernel produces it."""
    real = app.kmeans_assign_reduce

    def altered(points, cen):
        sums, counts = real(points, cen)
        counts = counts.clone()
        counts[0] += 1.0
        return sums, counts

    return _patch(app, "kmeans_assign_reduce", altered)


def kmeans_exchange_left_out(app):
    """Each rank's partial sums and counts kept, the reduction across the
    ranks left out."""
    import repro_torch.core.launch as launch

    return _patch(launch, "collective_reduce_ranks", lambda op, x, axes: x)


def hotspot_state_unchanged(app):
    """Every step hands back the temperature it was given."""
    return _patch(app, "hotspot_step", lambda temp, power, **c: temp.clone())


def hotspot_half_batch(app):
    """The lower half of each slab's rows left as they were."""
    real = app.hotspot_step

    def half(temp, power, **c):
        out = real(temp, power, **c)
        mid = temp.shape[0] // 2
        out[mid:] = temp[mid:]
        return out

    return _patch(app, "hotspot_step", half)


def hotspot_answer_altered(app):
    """One cell of each step's output moved by a thousandth of the grid's
    largest magnitude."""
    real = app.hotspot_step

    def altered(temp, power, **c):
        out = real(temp, power, **c)
        out[1, 2] += 1e-3 * float(out.abs().max())
        return out

    return _patch(app, "hotspot_step", altered)


def hotspot_power_dropped(app):
    """Every step run without its power input."""
    real = app.hotspot_step
    return _patch(app, "hotspot_step", lambda temp, power, **c: real(
        temp, torch.zeros_like(power), **c))


def hotspot_ambient_dropped(app):
    """Every step run without its ambient term (rz = 0)."""
    real = app.hotspot_step
    return _patch(app, "hotspot_step", lambda temp, power, **c: real(
        temp, power, **{**c, "rz": 0.0}))


def hotspot_exchange_left_out(app):
    """Each rank's halo rows zeros: the exchange between the ranks left
    out."""
    import repro_torch.core.launch as launch

    def no_exchange(x, halo, axes, tracer, span):
        zero = torch.zeros_like(x[:1])
        return torch.cat([zero, x, zero])

    return _patch(launch, "_halo_exchange_ranks", no_exchange)
