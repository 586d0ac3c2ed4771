"""What the drivers share: the configuration handed to the program, the
reference law, and a sampler of work units drawn from the seed."""

from __future__ import annotations

import random

LAW_KEYS = ("world_size", "attraction_matrix", "min_pull_ratio",
            "interaction_force", "particle_effect_radius", "coefficient",
            "acceleration")


def sim_config(config: dict):
    """The program's ``SimConfig`` for a particle-life configuration file."""
    import numpy as np

    from particle3d_tpu_torch import SimConfig

    return SimConfig(
        world_size=float(config["world_size"]),
        attraction_matrix=np.asarray(config["attraction_matrix"], np.float32),
        min_pull_ratio=config["min_pull_ratio"],
        interaction_force=config["interaction_force"],
        particle_effect_radius=config["particle_effect_radius"],
        coefficient=config["coefficient"],
        acceleration=np.asarray(config["acceleration"], np.float32),
        id_count=config["id_count"], boundary=config["boundary"],
        integrator=config["integrator"], force_law=config["force_law"],
        neighbor="celllist_pallas", cell_grid=config["cell_grid"],
        cell_capacity=config["cell_capacity"],
        overflow_capacity=config.get("overflow_capacity")).validate()


def law(config: dict) -> dict:
    """The reference's law parameters of a configuration file."""
    return {k: config[k] for k in LAW_KEYS}


def chosen(seed: int, index: int, every: int) -> bool:
    """Whether work unit ``index`` is in the seed's sample, about one in
    ``every``; the same seed always picks the same units."""
    return random.Random(f"{seed}:{index}").randrange(every) == 0


def summarise(trace, pairs, n, wrap, extra=None):
    """What the metric readers read of the traced window."""
    s = {"steps": trace.steps, "window_s": trace.window_s,
         "busy_s": trace.busy_s(), "launches": trace.launches(),
         "force_s": trace.busy_s("force"),
         "pairs": pairs, "n": n, "wrap": wrap,
         "device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    s.update(extra or {})
    return s
