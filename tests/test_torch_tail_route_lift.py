"""The tail route held to the reference, second half: repeatmask and
liftover (the library's and ASM10's score sets) on the wavefront route, the
rest on the host engine, port against the JAX package's interpret-mode
route on bench_pipeline.tail_dataset, nine files byte for byte (tolerance:
none).  See test_torch_tail_route.py, which holds te_filter, annotate and af
on another pytest-xdist worker."""

import pytest

from test_torch_pipeline import OUTPUTS
from test_torch_tail_route import (check_byte_identical,
                                   check_calls_the_insertion,
                                   check_stages_ran_both_kernels,
                                   run_tail_route)

STAGES = ("repeatmask", "liftover")


@pytest.fixture(scope="module")
def route(tmp_path_factory):
    return run_tail_route(STAGES, tmp_path_factory)


@pytest.mark.parametrize("name", OUTPUTS)
def test_tail_route_byte_identical(route, name):
    check_byte_identical(route, name)


def test_tail_route_ran_both_kernels_in_each_stage(route):
    check_stages_ran_both_kernels(route, STAGES)


def test_tail_route_calls_the_insertion(route):
    check_calls_the_insertion(route)
