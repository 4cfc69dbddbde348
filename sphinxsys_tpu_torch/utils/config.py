"""Run configuration: CLI flags and parameter overrides (the port's
counterpart of sphinxsys_tpu/utils/config.py; reference sph_system.cpp
handleCommandlineOptions: --state_recording --log_level, and
ParameterizationIO's parameter file).  A dataclass + JSON file subsumes
both.  The reference's --relax, --reload, --regression and
--restart_step select paths that no case of the port has yet; they are
not accepted, so that argparse rejects them (exit code 2) rather than a
run ignoring them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from typing import Any, Dict


@dataclasses.dataclass
class RunConfig:
    """The standard run flags every case accepts."""

    state_recording: bool = True     # write VTP body states
    log_level: int = 20              # logging level (logging.INFO)
    output_dir: str = "output"
    parameters: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_cli(cls, argv=None) -> "RunConfig":
        p = argparse.ArgumentParser(description="sphinxsys_tpu_torch case runner")
        p.add_argument("--no-state-recording", dest="state_recording",
                       action="store_false")
        p.add_argument("--log_level", type=int, default=20)
        p.add_argument("--output_dir", default="output")
        p.add_argument("--parameter_file", default=None,
                       help="JSON file of case-parameter overrides "
                            "(ParameterizationIO counterpart)")
        p.add_argument("--set", action="append", default=[], metavar="K=V",
                       help="inline parameter override (repeatable)")
        a = p.parse_args(argv)
        params: Dict[str, Any] = {}
        if a.parameter_file:
            with open(a.parameter_file) as f:
                params.update(json.load(f))
        for kv in a.set:
            k, v = kv.split("=", 1)
            try:
                params[k] = json.loads(v)
            except json.JSONDecodeError:
                params[k] = v
        cfg = cls(state_recording=a.state_recording, log_level=a.log_level,
                  output_dir=a.output_dir, parameters=params)
        cfg.setup_logging()
        return cfg

    def setup_logging(self):
        logging.basicConfig(
            level=self.log_level,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    def param(self, name: str, default):
        """Case-parameter lookup with override (ParameterizationIO
        semantics: the file value wins over the case default)."""
        return self.parameters.get(name, default)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls(**json.load(f))
