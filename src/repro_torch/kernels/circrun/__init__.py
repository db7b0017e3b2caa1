"""circrun: longest circular run of matching symbols (|LCCS| per row)."""
from .ops import circrun
from .ref import circrun_ref

__all__ = ["circrun", "circrun_ref"]
