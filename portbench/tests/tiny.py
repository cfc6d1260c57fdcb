"""Configurations a CPU test run can hold: the cells' own files with the
widths, the horizon and the chain cut down."""

from portbench import spec


def unet():
    cfg = spec.load_config("unet_umaze")
    cfg.update(dim=8, dim_mults=[1, 2], horizon=8, n_timesteps=5,
               action_horizon=4)
    return cfg


def transformer():
    cfg = spec.load_config("transformer_umaze")
    cfg.update(dim=16, depth=1, n_heads=2, horizon=8, n_timesteps=5,
               action_horizon=4)
    return cfg


def traffic(name, **kw):
    tr = spec.load_traffic(name)
    if tr["runner"] == "eval":
        tr.update(batch=8, check_envs=4)
    tr.update(kw)
    return tr
