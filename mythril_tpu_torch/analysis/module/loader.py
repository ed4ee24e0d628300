"""Detection module registry.

Parity surface: mythril/analysis/module/loader.py — a singleton holding
the 14 built-in detectors (declared as a table, instantiated lazily), the
env-gated static-analysis probe, plus anything third-party plugins
register at runtime."""

from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.exceptions import DetectorNotFoundError
from mythril_tpu_torch.support.support_utils import Singleton

# (module path, class name) for every built-in detector
_BUILTIN_DETECTORS = [
    ("mythril_tpu_torch.analysis.module.modules.arbitrary_jump", "ArbitraryJump"),
    ("mythril_tpu_torch.analysis.module.modules.arbitrary_write", "ArbitraryStorage"),
    ("mythril_tpu_torch.analysis.module.modules.delegatecall", "ArbitraryDelegateCall"),
    (
        "mythril_tpu_torch.analysis.module.modules.dependence_on_predictable_vars",
        "PredictableVariables",
    ),
    ("mythril_tpu_torch.analysis.module.modules.dependence_on_origin", "TxOrigin"),
    ("mythril_tpu_torch.analysis.module.modules.ether_thief", "EtherThief"),
    ("mythril_tpu_torch.analysis.module.modules.exceptions", "Exceptions"),
    ("mythril_tpu_torch.analysis.module.modules.external_calls", "ExternalCalls"),
    ("mythril_tpu_torch.analysis.module.modules.integer", "IntegerArithmetics"),
    ("mythril_tpu_torch.analysis.module.modules.multiple_sends", "MultipleSends"),
    (
        "mythril_tpu_torch.analysis.module.modules.state_change_external_calls",
        "StateChangeAfterCall",
    ),
    ("mythril_tpu_torch.analysis.module.modules.suicide", "AccidentallyKillable"),
    ("mythril_tpu_torch.analysis.module.modules.unchecked_retval", "UncheckedRetval"),
    ("mythril_tpu_torch.analysis.module.modules.user_assertions", "UserAssertions"),
]


class ModuleLoader(object, metaclass=Singleton):
    """Process-wide registry of detection modules."""

    def __init__(self):
        self._modules: List[DetectionModule] = []
        self._load_builtins()

    def _load_builtins(self) -> None:
        import os
        from importlib import import_module

        detectors = list(_BUILTIN_DETECTORS)
        # the static-pass probe is a POST module: merely registering it
        # forces statespace retention (analysis/symbolic.py), so it only
        # joins the registry when explicitly enabled — the default SWC
        # finding set stays byte-identical with the static pass on or off
        if os.environ.get("MYTHRIL_TPU_STATIC_PROBE"):
            detectors.append(
                (
                    "mythril_tpu_torch.analysis.module.modules.static_probe",
                    "StaticAnalysisProbe",
                )
            )
        for module_path, class_name in detectors:
            cls = getattr(import_module(module_path), class_name)
            self._modules.append(cls())

    def register_module(self, detection_module: DetectionModule):
        """Used by the plugin discovery system for third-party detectors."""
        if not isinstance(detection_module, DetectionModule):
            raise ValueError("The passed variable is not a valid detection module")
        self._modules.append(detection_module)

    def get_detection_modules(
        self,
        entry_point: Optional[EntryPoint] = None,
        white_list: Optional[List[str]] = None,
    ) -> List[DetectionModule]:
        selected = list(self._modules)
        if white_list:
            known = {type(module).__name__ for module in selected}
            unknown = [name for name in white_list if name not in known]
            if unknown:
                raise DetectorNotFoundError(
                    "Invalid detection module: {}".format(unknown[0])
                )
            selected = [
                module for module in selected if type(module).__name__ in white_list
            ]
        if entry_point:
            selected = [
                module for module in selected if module.entry_point == entry_point
            ]
        return selected
