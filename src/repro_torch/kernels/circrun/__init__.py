"""circrun: longest circular run of matching symbols (|LCCS| per row), and
the top-k of those lengths (`circrun_topk`)."""
from .ops import circrun, circrun_topk
from .ref import circrun_ref, circrun_topk_plain

__all__ = ["circrun", "circrun_ref", "circrun_topk", "circrun_topk_plain"]
