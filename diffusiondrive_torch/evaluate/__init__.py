"""Evaluation package (counterpart of `diffusiondrive_tpu/evaluate/__init__.py`).
Exports are lazy: `common.dataloader` imports `evaluate.metric_cache`, so
eager re-exports here would create an import cycle through
`evaluate.runner`. The vehicle parameters live in `evaluate.state_array`."""

_EXPORTS = {
    "MetricCache": "diffusiondrive_torch.evaluate.metric_cache",
    "pdm_score": "diffusiondrive_torch.evaluate.pdm_score",
    "batched_pdm_score": "diffusiondrive_torch.evaluate.pdm_score",
    "run_pdm_score_evaluation": "diffusiondrive_torch.evaluate.runner",
    "write_score_csv": "diffusiondrive_torch.evaluate.runner",
    "PDMScorerConfig": "diffusiondrive_torch.evaluate.scorer",
    "ScorerOutput": "diffusiondrive_torch.evaluate.scorer",
    "score_proposals": "diffusiondrive_torch.evaluate.scorer",
    "PDMSimulator": "diffusiondrive_torch.evaluate.simulator",
    "VehicleParameters": "diffusiondrive_torch.evaluate.state_array",
    "get_pacifica_parameters": "diffusiondrive_torch.evaluate.state_array",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'diffusiondrive_torch.evaluate' has no attribute '{name}'")
