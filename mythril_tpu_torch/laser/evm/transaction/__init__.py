from mythril_tpu_torch.laser.evm.transaction.transaction_models import (
    BaseTransaction,
    ContractCreationTransaction,
    MessageCallTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
    get_next_transaction_id,
    transfer_ether,
)
from mythril_tpu_torch.laser.evm.transaction.symbolic import (
    ACTORS,
    execute_contract_creation,
    execute_message_call,
)
