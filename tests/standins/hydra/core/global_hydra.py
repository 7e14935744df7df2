"""`hydra.core.global_hydra` of the stand-in: the one global configuration of a process."""


class GlobalHydra:
    _instance = None

    def __init__(self):
        self.config_dir = None

    @classmethod
    def instance(cls) -> "GlobalHydra":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def is_initialized(self) -> bool:
        return self.config_dir is not None

    def clear(self) -> None:
        self.config_dir = None
