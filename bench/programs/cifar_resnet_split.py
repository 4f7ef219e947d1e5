"""The split CIFAR ResNet of the SFPL paper (``model.arch``
``cifar_resnet_split``): an adapter over the functions that hold its
set-up (``run.checked_program``, through ``sut.py``), its plain reference
(``run.checked_reference``, through ``reference.py``) and its readings
(``compare.numbers``). Each is reached through its module at call time.

A unit of the window is one SFPL epoch over every client's images."""
from bench import compare, run

FAULTS = {"control": {"precision": "fp8"},
          "half_batch": {"drop_half": "clients"},
          "half_rows": {"drop_half": "rows"},
          "bf16_witness": {"precision": "bfloat16"},
          "frozen": {"frozen": True}}


class Runner:
    """The program after its checked steps, driven one epoch at a time."""

    def __init__(self, cell, prog, st, data, perm_gen):
        self.prog, self.st = prog, st
        self.data, self.perm_gen = data, perm_gen
        batch = cell.traffic["client_batch"]
        dep = cell.config["deployment"]
        self.steps_per_unit = dep["samples_per_client"] // batch
        # the client samples an epoch consumes: a client's last partial
        # batch is left out by the program
        self.samples_per_unit = dep["clients"] * self.steps_per_unit * batch

    def unit(self):
        self.st, losses = self.prog.epoch(self.perm_gen, self.st, self.data)
        return losses

    def free(self):
        self.prog = self.st = self.data = None


def checked(cell, seed, dev):
    prog, st, data, perm_gen, out = run.checked_program(cell, seed, dev)
    return Runner(cell, prog, st, data, perm_gen), out


def reference(cell, seed, dev, **fault):
    return run.checked_reference(cell, seed, dev, **fault)


def numbers(got, want):
    return compare.numbers(got, want)
