"""Issues and reports (reference surface: mythril/analysis/report.py).

Renders text / markdown / json / jsonv2 without external template files."""

import hashlib
import json
import logging
import operator
from typing import Any, Dict, List

from mythril_tpu_torch.analysis.swc_data import SWC_TO_TITLE
from mythril_tpu_torch.support.source_support import Source
from mythril_tpu_torch.support.start_time import StartTime  # noqa: F401

log = logging.getLogger(__name__)


class Issue:
    """A single reported vulnerability."""

    def __init__(
        self,
        contract: str,
        function_name: str,
        address: int,
        swc_id: str,
        title: str,
        bytecode: str,
        gas_used=(None, None),
        severity=None,
        description_head="",
        description_tail="",
        transaction_sequence=None,
    ):
        self.title = title
        self.contract = contract
        self.function = function_name
        self.address = address
        self.description_head = description_head
        self.description_tail = description_tail
        self.description = "%s\n%s" % (description_head, description_tail)
        self.severity = severity
        self.swc_id = swc_id
        self.min_gas_used, self.max_gas_used = gas_used
        self.filename = None
        self.code = None
        self.lineno = None
        self.source_mapping = None
        self.discovery_time = None
        self.bytecode_hash = get_code_hash(bytecode) if bytecode else ""
        self.transaction_sequence = transaction_sequence
        self.source_location = None

    @property
    def transaction_sequence_users(self):
        """Transaction sequence with user-readable fields."""
        return self.transaction_sequence

    @property
    def transaction_sequence_jsonv2(self):
        return self.transaction_sequence

    @property
    def as_dict(self) -> Dict[str, Any]:
        issue = {
            "title": self.title,
            "swc-id": self.swc_id,
            "contract": self.contract,
            "description": self.description,
            "function": self.function,
            "severity": self.severity,
            "address": self.address,
            "tx_sequence": self.transaction_sequence,
            "min_gas_used": self.min_gas_used,
            "max_gas_used": self.max_gas_used,
        }
        if self.filename and self.lineno:
            issue["filename"] = self.filename
            issue["lineno"] = self.lineno
        if self.code:
            issue["code"] = self.code
        return issue

    def add_code_info(self, contract) -> None:
        """Attach source-code mapping info from a SolidityContract."""
        if self.address and isinstance(contract, object):
            if not hasattr(contract, "get_source_info"):
                return
            codeinfo = contract.get_source_info(
                self.address, constructor=(self.function == "constructor")
            )
            if codeinfo is None:
                return
            self.filename = codeinfo.filename
            self.code = codeinfo.code
            self.lineno = codeinfo.lineno
            self.source_mapping = codeinfo.solc_mapping

    def resolve_function_name(self, contract) -> None:
        pass


def get_code_hash(bytecode: str) -> str:
    from mythril_tpu_torch.support.support_utils import get_code_hash as _gch

    return _gch(bytecode)


class Report:
    """A collection of issues renderable in several formats."""

    environment: Dict[str, Any] = {}

    def __init__(self, contracts=None, exceptions=None):
        self.issues: Dict[bytes, Issue] = {}
        self.solc_version = ""
        self.meta: Dict[str, Any] = {}
        self.source = Source()
        self.source.get_source_from_contracts_list(contracts)
        self.exceptions = exceptions or []

    def sorted_issues(self) -> List[Dict]:
        issue_list = [issue.as_dict for issue in self.issues.values()]
        return sorted(issue_list, key=operator.itemgetter("address", "title"))

    def append_issue(self, issue: Issue, detection_reference=None) -> None:
        m = hashlib.md5()
        m.update(
            (issue.contract + str(issue.address) + issue.title + (issue.severity or "")).encode(
                "utf-8"
            )
        )
        issue.discovery_time = 0.0
        self.issues[m.digest()] = issue

    def as_text(self) -> str:
        """Plain-text rendering."""
        if not self.issues:
            return "The analysis was completed successfully. No issues were detected."
        lines = []
        for issue in self.sorted_issues():
            lines.append("==== %s ====" % issue["title"])
            lines.append("SWC ID: %s" % issue["swc-id"])
            lines.append("Severity: %s" % issue["severity"])
            lines.append("Contract: %s" % issue["contract"])
            lines.append("Function name: %s" % issue["function"])
            lines.append("PC address: %s" % issue["address"])
            lines.append(
                "Estimated Gas Usage: %s - %s"
                % (issue["min_gas_used"], issue["max_gas_used"])
            )
            lines.append(issue["description"])
            if "filename" in issue:
                lines.append("--------------------")
                lines.append("In file: %s:%s" % (issue["filename"], issue["lineno"]))
            if "code" in issue:
                lines.append("")
                lines.append(issue["code"])
            lines.append("--------------------")
            lines.append("")
        return "\n".join(lines)

    def as_markdown(self) -> str:
        if not self.issues:
            return "# Analysis results\n\nThe analysis was completed successfully. No issues were detected."
        lines = ["# Analysis results"]
        for issue in self.sorted_issues():
            lines.append("## %s" % issue["title"])
            lines.append("- SWC ID: %s" % issue["swc-id"])
            lines.append("- Severity: %s" % issue["severity"])
            lines.append("- Contract: %s" % issue["contract"])
            lines.append("- Function name: `%s`" % issue["function"])
            lines.append("- PC address: %s" % issue["address"])
            lines.append(
                "- Estimated Gas Usage: %s - %s"
                % (issue["min_gas_used"], issue["max_gas_used"])
            )
            lines.append("")
            lines.append("### Description")
            lines.append(issue["description"])
            if "filename" in issue:
                lines.append("In file: %s:%s" % (issue["filename"], issue["lineno"]))
            lines.append("")
        return "\n".join(lines)

    def as_json(self) -> str:
        result = {"success": True, "error": None, "issues": self.sorted_issues()}
        return json.dumps(result, sort_keys=True)

    def _get_exception_data(self) -> dict:
        if not self.exceptions:
            return {}
        logs: List[Dict] = []
        for exception in self.exceptions:
            logs += [{"level": "error", "hidden": True, "msg": exception}]
        return {"logs": logs}

    def as_swc_standard_format(self) -> str:
        """SWC-registry style jsonv2 rendering."""
        _issues = []
        for _, issue in self.issues.items():
            idx = self.source.get_source_index(issue.bytecode_hash)
            try:
                title = SWC_TO_TITLE[issue.swc_id]
            except KeyError:
                title = "Unspecified Security Issue"
            extra = {"discoveryTime": int((issue.discovery_time or 0) * 10**9)}
            if issue.transaction_sequence:
                extra["testCases"] = [issue.transaction_sequence]
            _issues.append(
                {
                    "swcID": "SWC-" + (issue.swc_id or ""),
                    "swcTitle": title,
                    "description": {
                        "head": issue.description_head,
                        "tail": issue.description_tail,
                    },
                    "severity": issue.severity,
                    "locations": [{"sourceMap": "%d:1:%d" % (issue.address, idx)}],
                    "extra": extra,
                }
            )
        meta_data = self._get_exception_data()
        result = [
            {
                "issues": _issues,
                "sourceType": self.source.source_type,
                "sourceFormat": self.source.source_format,
                "sourceList": self.source.source_list,
                "meta": meta_data,
            }
        ]
        return json.dumps(result, sort_keys=True)
