"""The port's copies of the jax-free utilities its wire needs."""

from .config import (get_default_transport, get_hostname, get_namespace,
                     get_pid)
from .logger import TopicLogHandler, get_log_level, get_logger
from .sexpr import (SExprError, generate, generate_expression, parse,
                    parse_float, parse_int, parse_number, parse_tree)
from .state_machine import StateMachine, StateMachineError

__all__ = ["SExprError", "TopicLogHandler", "generate",
           "generate_expression", "get_default_transport", "get_hostname",
           "get_log_level", "get_logger", "get_namespace", "get_pid",
           "parse", "parse_float", "parse_int", "parse_number",
           "parse_tree", "StateMachine", "StateMachineError"]
