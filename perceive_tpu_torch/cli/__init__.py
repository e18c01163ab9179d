from .main import build_parser, dispatch, main
from .state import AppState

__all__ = ["AppState", "build_parser", "dispatch", "main"]
