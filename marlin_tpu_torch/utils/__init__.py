from .profiling import evaluate, timer  # noqa: F401
