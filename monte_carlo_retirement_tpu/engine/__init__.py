"""The compiled engine (``Engine``) and the reference-compatible facade
(``RetirementMonteCarloSimulator``), imported lazily: the facade needs
pandas, the engine does not."""

__all__ = ["Engine", "RetirementMonteCarloSimulator"]


def __getattr__(name):
    if name == "Engine":
        from .runner import Engine

        return Engine
    if name == "RetirementMonteCarloSimulator":
        from .simulator import RetirementMonteCarloSimulator

        return RetirementMonteCarloSimulator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
