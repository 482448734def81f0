"""Hyperparameter optimization engine (Optuna-style, no optuna
dependency), the JAX package's ``hyperopt/`` on one device:

- Study / Trial ask-tell API with suggest_float/int/categorical
- TPESampler (Parzen-estimator based) + RandomSampler, numpy draws
- MedianPruner, SuccessiveHalvingPruner, NopPruner
- SQLite storage with load_if_exists resume, the JAX package's schema
- TrialPruned control-flow exception
- the k-fold objective and the sequential runner
"""

from irp_tpu_torch.hyperopt.distributions import (  # noqa: F401
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)
from irp_tpu_torch.hyperopt.study import (  # noqa: F401
    Study,
    Trial,
    TrialPruned,
    TrialState,
    create_study,
)
from irp_tpu_torch.hyperopt.samplers import (  # noqa: F401
    RandomSampler, TPESampler)
from irp_tpu_torch.hyperopt.pruners import (  # noqa: F401
    MedianPruner, NopPruner, SuccessiveHalvingPruner)
from irp_tpu_torch.hyperopt.objective import (  # noqa: F401
    HyperoptContext,
    objective_kfold,
    quick_space,
    suggest_space,
)
from irp_tpu_torch.hyperopt.runner import (  # noqa: F401
    run_kfold_optimization)
from irp_tpu_torch.hyperopt.analysis import (  # noqa: F401
    enhanced_optuna_analysis,
    study_statistics,
    visualize_best_trial_metrics,
)
