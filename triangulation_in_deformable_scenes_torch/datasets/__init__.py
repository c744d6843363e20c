"""Dataset loaders (host-side IO): Drunkard's Dataset, RealColon, Syncolon."""

from .loaders import DrunkardLoader, RealcolonLoader, SyncolonLoader  # noqa: F401
