"""The paper's contribution: Clustering-Sampling-Voting semantic filtering.

Public API (ported so far):
    semantic_filter(...)                                    — Algorithm 1
    uni_vote / sim_vote                                     — Algorithms 2/3
    xi_for_epsilon_*                                        — Theorems 3.3/3.6
"""
from repro_torch.core.theory import (xi_for_epsilon_univote,
                                     xi_for_epsilon_simvote,
                                     vote_error_bound, epsilon_for_xi,
                                     bernstein_tail, choose_sample_size)
from repro_torch.core.clustering import (kmeans, kmeans_predict,
                                         minibatch_kmeans_update,
                                         plusplus_init)
from repro_torch.core.voting import (uni_vote, sim_vote, uni_vote_batch,
                                     sim_vote_batch, vote_clusters)
from repro_torch.core.csv_filter import (CSVConfig, FilterResult, RoundPlan,
                                         RoundResult, plan_round,
                                         semantic_filter)
from repro_torch.core.oracle import (SyntheticOracle, ModelOracle,
                                     OracleStats, ProxyModel, StatsScope,
                                     SyncOracleDispatcher,
                                     AsyncOracleDispatcher)
