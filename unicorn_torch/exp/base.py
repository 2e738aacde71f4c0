"""The experiment base class and the loaders of experiment files (port of
unicorn_tpu/exp/base.py): BaseExp with the command line's `merge` (values
coerced by literal_eval to the field's type, a leading "--" stripped,
unknown keys ignored) and the evaluator factories, get_exp_by_file,
get_exp_by_name (the port's copies in unicorn_torch/exp/, which import no
JAX; the JAX package's loader reads exps/default/, whose files import
unicorn_tpu) and get_exp."""
from __future__ import annotations

import ast
import importlib
import importlib.util
import inspect
import os
import pprint
import sys
from abc import ABC, abstractmethod

EXP_DIR = os.path.dirname(os.path.abspath(__file__))


class BaseExp(ABC):
    """Basic class for any experiment."""

    seed = None
    output_dir = "./Unicorn_outputs"
    print_interval = 100
    eval_interval = 10

    @abstractmethod
    def get_model(self):
        ...

    def get_trainer_evaluator(self, batch_size=1, device="cuda"):
        """The evaluator of the Trainer's in-training eval and `best`
        checkpoint: get_evaluator() with those of batch_size and device that
        it takes. The track exps override it with a COCO box evaluator: the
        reference evaluates detection AP during uni training
        (unicorn_track.py:402-443), not MOT metrics."""
        accepted = inspect.signature(self.get_evaluator).parameters
        kw = {k: v for k, v in (("batch_size", batch_size),
                                ("device", device)) if k in accepted}
        return self.get_evaluator(**kw)

    def get_evaluator(self):
        """The exp's evaluator (tools/eval.py); an exp without one raises,
        which the Trainer reads as "no in-training eval"."""
        raise NotImplementedError(f"{type(self).__name__} has no evaluator")

    def eval(self, model, evaluator, max_images=None):
        """evaluator.evaluate on `model` through the forward the exp's
        evaluator takes (tools/eval.py)."""
        raise NotImplementedError(f"{type(self).__name__} has no eval")

    def __repr__(self):
        return "\n".join(f"{k:25s}: {pprint.pformat(v)}"
                         for k, v in vars(self).items()
                         if not k.startswith("_"))

    def merge(self, cfg_list):
        """Command-line overrides ['key', 'value', ...]: a key may start
        with "--"; a key the experiment lacks is ignored; a value is
        literal_eval'd unless the field is None or a string (a value that
        does not parse stays a string)."""
        if len(cfg_list) % 2:
            raise ValueError(f"merge takes key / value pairs, got "
                             f"{cfg_list!r}")
        for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
            if k.startswith("--"):
                k = k[2:]
            if not hasattr(self, k):
                continue
            src = getattr(self, k)
            if src is not None and not isinstance(src, str):
                try:
                    v = ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    pass
            setattr(self, k, v)


def get_exp_by_file(exp_file: str):
    """Exp() of a Python file (its directory is put on sys.path, so that it
    can import its neighbours)."""
    sys.path.append(os.path.dirname(exp_file))
    spec = importlib.util.spec_from_file_location("current_exp", exp_file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Exp()


def get_exp_by_name(exp_name: str):
    """Exp() of the port's copy of exps/default/<exp_name>.py ("-" read as
    "_"), unicorn_torch/exp/<exp_name>.py."""
    name = exp_name.replace("-", "_")
    if not os.path.isfile(os.path.join(EXP_DIR, name + ".py")):
        raise FileNotFoundError(f"no experiment {exp_name!r} in {EXP_DIR}")
    return importlib.import_module(f"{__package__}.{name}").Exp()


def get_exp(exp_file=None, exp_name=None):
    """The experiment of a file, else of a name."""
    if exp_file is not None:
        return get_exp_by_file(exp_file)
    if exp_name is not None:
        return get_exp_by_name(exp_name)
    raise ValueError("get_exp needs exp_file or exp_name")
