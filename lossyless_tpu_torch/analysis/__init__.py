"""Analysis: result aggregation and plots, the linear probe, the kaggle
writer and the analyser of trained experiments. The names load lazily:
`analysis.kaggle` and `analysis.linear_eval` import neither pandas nor
matplotlib."""

from .._lazy import exports

__all__, __getattr__, __dir__ = exports(__name__, {
    "ResultAggregator": ".aggregate", "plot_hypopt": ".aggregate",
    "plot_pareto_front": ".aggregate", "plot_rd_curves": ".aggregate",
    "z_linear_eval": ".linear_eval", "PretrainedAnalyser": ".pretrained"})
