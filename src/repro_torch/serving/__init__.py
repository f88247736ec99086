from .engine import Engine, ServeConfig, make_serve_step

__all__ = ["Engine", "ServeConfig", "make_serve_step"]
