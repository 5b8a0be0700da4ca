"""One-command real-data accuracy gate (ACCURACY.md protocol), on the port.

A thin CLI over ``algonauts2025_tpu_torch.experiment.accuracy_gate``; see
that module's docstring for the stages, thresholds, interchange format and
the four verdicts in which it differs from the JAX package's gate.

    python -m algonauts2025_tpu_torch.scripts.real_data_gate \
        --ref-features /path/to/exported_reference_features \
        --ref-metrics  /path/to/reference_metrics.csv \
        [--seeds 33 34 35] [--out gate_report.json] [key=value ...]

Exit code 0 only when every stage ran AND passed.
"""

import sys

from ..experiment.accuracy_gate import main

if __name__ == "__main__":
    sys.exit(main())
