from repro_torch.sharding.rules import (ShardingRules, current_rules,
                                        make_rules, shard, use_rules)

__all__ = ["ShardingRules", "current_rules", "make_rules", "shard",
           "use_rules"]
