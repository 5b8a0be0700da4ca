from .confdict import ConfDict
from .uid import config_uid, dump_for_uid
