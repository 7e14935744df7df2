"""`isaacgymenvs.utils.reformat` of the stand-in."""


def omegaconf_to_dict(d) -> dict:
    """The composed config as plain nested dicts."""
    return {k: omegaconf_to_dict(v) if isinstance(v, dict) else v for k, v in d.items()}
